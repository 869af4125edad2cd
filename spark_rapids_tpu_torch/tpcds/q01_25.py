"""TPC-DS queries 1-25 as SQL text (see queries_sql.py for the battery
notes: spec query shapes — CTE reuse, decorrelated subqueries, rollups,
windows — with parameters landing in the generator's value domains).

Copied from ``spark_rapids_tpu/tpcds/q01_25.py``.
"""

Q = {}

Q[1] = """
with customer_total_return as (
  select sr_customer_sk as ctr_customer_sk, sr_store_sk as ctr_store_sk,
         sum(sr_return_amt) as ctr_total_return
  from store_returns, date_dim
  where sr_returned_date_sk = d_date_sk and d_year = 2000
  group by sr_customer_sk, sr_store_sk)
select c_customer_id
from customer_total_return ctr1, store, customer
where ctr1.ctr_total_return > (select avg(ctr_total_return) * 1.2
                               from customer_total_return ctr2
                               where ctr1.ctr_store_sk = ctr2.ctr_store_sk)
  and s_store_sk = ctr1.ctr_store_sk and s_state = 'AL'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id
limit 100
"""

Q[2] = """
with wscs as (
  select sold_date_sk, sales_price
  from (select ws_sold_date_sk sold_date_sk, ws_ext_sales_price sales_price
        from web_sales
        union all
        select cs_sold_date_sk sold_date_sk, cs_ext_sales_price sales_price
        from catalog_sales) x),
 wswscs as (
  select d_week_seq,
         sum(case when d_day_name = 'Sunday' then sales_price else null end)
           sun_sales,
         sum(case when d_day_name = 'Monday' then sales_price else null end)
           mon_sales,
         sum(case when d_day_name = 'Tuesday' then sales_price else null end)
           tue_sales,
         sum(case when d_day_name = 'Wednesday' then sales_price else null end)
           wed_sales,
         sum(case when d_day_name = 'Thursday' then sales_price else null end)
           thu_sales,
         sum(case when d_day_name = 'Friday' then sales_price else null end)
           fri_sales,
         sum(case when d_day_name = 'Saturday' then sales_price else null end)
           sat_sales
  from wscs, date_dim
  where d_date_sk = sold_date_sk
  group by d_week_seq)
select d_week_seq1, round(sun_sales1 / sun_sales2, 2),
       round(mon_sales1 / mon_sales2, 2), round(tue_sales1 / tue_sales2, 2),
       round(wed_sales1 / wed_sales2, 2), round(thu_sales1 / thu_sales2, 2),
       round(fri_sales1 / fri_sales2, 2), round(sat_sales1 / sat_sales2, 2)
from (select wswscs.d_week_seq d_week_seq1, sun_sales sun_sales1,
             mon_sales mon_sales1, tue_sales tue_sales1,
             wed_sales wed_sales1, thu_sales thu_sales1,
             fri_sales fri_sales1, sat_sales sat_sales1
      from wswscs, date_dim
      where date_dim.d_week_seq = wswscs.d_week_seq and d_year = 2000) y,
     (select wswscs.d_week_seq d_week_seq2, sun_sales sun_sales2,
             mon_sales mon_sales2, tue_sales tue_sales2,
             wed_sales wed_sales2, thu_sales thu_sales2,
             fri_sales fri_sales2, sat_sales sat_sales2
      from wswscs, date_dim
      where date_dim.d_week_seq = wswscs.d_week_seq and d_year = 2001) z
where d_week_seq1 = d_week_seq2 - 53
order by d_week_seq1
"""

Q[3] = """
select d_year, i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) sum_agg
from date_dim dt, store_sales, item
where dt.d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manufact_id = 128 and dt.d_moy = 11
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, brand_id
limit 100
"""

Q[4] = """
with year_total as (
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name, d_year dyear,
         sum(((ss_ext_list_price - ss_ext_wholesale_cost
               - ss_ext_discount_amt) + ss_ext_sales_price) / 2) year_total,
         's' sale_type
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk and ss_sold_date_sk = d_date_sk
  group by c_customer_id, c_first_name, c_last_name, d_year
  union all
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name, d_year dyear,
         sum(((cs_ext_list_price - cs_ext_wholesale_cost
               - cs_ext_discount_amt) + cs_ext_sales_price) / 2) year_total,
         'c' sale_type
  from customer, catalog_sales, date_dim
  where c_customer_sk = cs_bill_customer_sk and cs_sold_date_sk = d_date_sk
  group by c_customer_id, c_first_name, c_last_name, d_year
  union all
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name, d_year dyear,
         sum(((ws_ext_list_price - ws_ext_wholesale_cost
               - ws_ext_discount_amt) + ws_ext_sales_price) / 2) year_total,
         'w' sale_type
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk and ws_sold_date_sk = d_date_sk
  group by c_customer_id, c_first_name, c_last_name, d_year)
select t_s_secyear.customer_id, t_s_secyear.customer_first_name,
       t_s_secyear.customer_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_c_firstyear, year_total t_c_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_c_secyear.customer_id
  and t_s_firstyear.customer_id = t_c_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.sale_type = 's' and t_c_firstyear.sale_type = 'c'
  and t_w_firstyear.sale_type = 'w' and t_s_secyear.sale_type = 's'
  and t_c_secyear.sale_type = 'c' and t_w_secyear.sale_type = 'w'
  and t_s_firstyear.dyear = 2001 and t_s_secyear.dyear = 2002
  and t_c_firstyear.dyear = 2001 and t_c_secyear.dyear = 2002
  and t_w_firstyear.dyear = 2001 and t_w_secyear.dyear = 2002
  and t_s_firstyear.year_total > 0 and t_c_firstyear.year_total > 0
  and t_w_firstyear.year_total > 0
  and t_c_secyear.year_total / t_c_firstyear.year_total
        > t_s_secyear.year_total / t_s_firstyear.year_total
  and t_c_secyear.year_total / t_c_firstyear.year_total
        > t_w_secyear.year_total / t_w_firstyear.year_total
order by t_s_secyear.customer_id, t_s_secyear.customer_first_name,
         t_s_secyear.customer_last_name
limit 100
"""

Q[5] = """
with ssr as (
  select s_store_id, sum(sales_price) as sales, sum(profit) as profit,
         sum(return_amt) as returns_, sum(net_loss) as profit_loss
  from (select ss_store_sk as store_sk, ss_sold_date_sk as date_sk,
               ss_ext_sales_price as sales_price, ss_net_profit as profit,
               cast(0.0 as double) as return_amt, cast(0.0 as double) as net_loss
        from store_sales
        union all
        select sr_store_sk as store_sk, sr_returned_date_sk as date_sk,
               cast(0.0 as double) as sales_price, cast(0.0 as double) as profit,
               sr_return_amt as return_amt, sr_net_loss as net_loss
        from store_returns) salesreturns,
       date_dim, store
  where date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-08-23' + interval '14' day
    and store_sk = s_store_sk
  group by s_store_id),
 csr as (
  select cp_catalog_page_id, sum(sales_price) as sales, sum(profit) as profit,
         sum(return_amt) as returns_, sum(net_loss) as profit_loss
  from (select cs_catalog_page_sk as page_sk, cs_sold_date_sk as date_sk,
               cs_ext_sales_price as sales_price, cs_net_profit as profit,
               cast(0.0 as double) as return_amt, cast(0.0 as double) as net_loss
        from catalog_sales
        union all
        select cr_catalog_page_sk as page_sk, cr_returned_date_sk as date_sk,
               cast(0.0 as double) as sales_price, cast(0.0 as double) as profit,
               cr_return_amount as return_amt, cr_net_loss as net_loss
        from catalog_returns) salesreturns,
       date_dim, catalog_page
  where date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-08-23' + interval '14' day
    and page_sk = cp_catalog_page_sk
  group by cp_catalog_page_id),
 wsr as (
  select web_site_id, sum(sales_price) as sales, sum(profit) as profit,
         sum(return_amt) as returns_, sum(net_loss) as profit_loss
  from (select ws_web_site_sk as wsr_web_site_sk, ws_sold_date_sk as date_sk,
               ws_ext_sales_price as sales_price, ws_net_profit as profit,
               cast(0.0 as double) as return_amt, cast(0.0 as double) as net_loss
        from web_sales
        union all
        select ws_web_site_sk as wsr_web_site_sk,
               wr_returned_date_sk as date_sk,
               cast(0.0 as double) as sales_price, cast(0.0 as double) as profit,
               wr_return_amt as return_amt, wr_net_loss as net_loss
        from web_returns left outer join web_sales
          on wr_item_sk = ws_item_sk and wr_order_number = ws_order_number
       ) salesreturns,
       date_dim, web_site
  where date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-08-23' + interval '14' day
    and wsr_web_site_sk = web_site_sk
  group by web_site_id)
select channel, id, sum(sales) as sales, sum(returns_) as returns_,
       sum(profit) as profit
from (select 'store channel' as channel, 'store' || s_store_id as id,
             sales, returns_, profit - profit_loss as profit
      from ssr
      union all
      select 'catalog channel' as channel,
             'catalog_page' || cp_catalog_page_id as id,
             sales, returns_, profit - profit_loss as profit
      from csr
      union all
      select 'web channel' as channel, 'web_site' || web_site_id as id,
             sales, returns_, profit - profit_loss as profit
      from wsr) x
group by rollup (channel, id)
order by channel nulls last, id nulls last, sales
limit 100
"""

Q[6] = """
select a.ca_state state, count(*) cnt
from customer_address a, customer c, store_sales s, date_dim d, item i
where a.ca_address_sk = c.c_current_addr_sk
  and c.c_customer_sk = s.ss_customer_sk and s.ss_sold_date_sk = d.d_date_sk
  and s.ss_item_sk = i.i_item_sk
  and d.d_month_seq = (select distinct d_month_seq from date_dim
                       where d_year = 2001 and d_moy = 1)
  and i.i_current_price > 1.2 * (select avg(j.i_current_price) from item j
                                 where j.i_category = i.i_category)
group by a.ca_state
having count(*) >= 10
order by cnt, state
limit 100
"""

Q[7] = """
select i_item_id, avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
  and ss_cdemo_sk = cd_demo_sk and ss_promo_sk = p_promo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N') and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
"""

Q[8] = """
select s_store_name, sum(ss_net_profit)
from store_sales, date_dim, store,
     (select ca_zip
      from (select substr(ca_zip, 1, 5) ca_zip
            from customer_address
            where substr(ca_zip, 1, 5) in ('24128', '57834', '13354',
              '15734', '78668', '76232', '62878', '82235', '78890', '60512',
              '26233', '51200', '63837', '40558', '81989', '88190', '35474',
              '10003', '10004', '10005', '10006', '10007', '10008', '10009')
            intersect
            select substr(ca_zip, 1, 5) ca_zip
            from customer_address ca, customer c
            where ca.ca_address_sk = c.c_current_addr_sk
              and c.c_preferred_cust_flag = 'Y'
            ) v1) v2
where ss_store_sk = s_store_sk and ss_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 1998
  and substr(s_zip, 1, 2) = substr(v2.ca_zip, 1, 2)
group by s_store_name
order by s_store_name
limit 100
"""

Q[9] = """
select case when (select count(*) from store_sales
                  where ss_quantity between 1 and 20) > 5000
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 1 and 20)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 1 and 20) end bucket1,
       case when (select count(*) from store_sales
                  where ss_quantity between 21 and 40) > 5000
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 21 and 40)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 21 and 40) end bucket2,
       case when (select count(*) from store_sales
                  where ss_quantity between 41 and 60) > 5000
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 41 and 60)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 41 and 60) end bucket3,
       case when (select count(*) from store_sales
                  where ss_quantity between 61 and 80) > 5000
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 61 and 80)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 61 and 80) end bucket4,
       case when (select count(*) from store_sales
                  where ss_quantity between 81 and 100) > 5000
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 81 and 100)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 81 and 100) end bucket5
from reason
where r_reason_sk = 1
"""

Q[10] = """
select cd_gender, cd_marital_status, cd_education_status, count(*) cnt1,
       cd_purchase_estimate, count(*) cnt2, cd_credit_rating, count(*) cnt3,
       cd_dep_count, count(*) cnt4, cd_dep_employed_count, count(*) cnt5,
       cd_dep_college_count, count(*) cnt6
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and ca_county in ('Ziebach County', 'Williamson County', 'Walker County',
                    'Salem County', 'Raleigh County')
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk and d_year = 2002
                and d_moy between 1 and 4)
  and (exists (select * from web_sales, date_dim
               where c.c_customer_sk = ws_bill_customer_sk
                 and ws_sold_date_sk = d_date_sk and d_year = 2002
                 and d_moy between 1 and 4)
    or exists (select * from catalog_sales, date_dim
               where c.c_customer_sk = cs_ship_customer_sk
                 and cs_sold_date_sk = d_date_sk and d_year = 2002
                 and d_moy between 1 and 4))
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
limit 100
"""

Q[11] = """
with year_total as (
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name, d_year dyear,
         sum(ss_ext_list_price - ss_ext_discount_amt) year_total,
         's' sale_type
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk and ss_sold_date_sk = d_date_sk
  group by c_customer_id, c_first_name, c_last_name, d_year
  union all
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name, d_year dyear,
         sum(ws_ext_list_price - ws_ext_discount_amt) year_total,
         'w' sale_type
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk and ws_sold_date_sk = d_date_sk
  group by c_customer_id, c_first_name, c_last_name, d_year)
select t_s_secyear.customer_id, t_s_secyear.customer_first_name,
       t_s_secyear.customer_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.sale_type = 's' and t_w_firstyear.sale_type = 'w'
  and t_s_secyear.sale_type = 's' and t_w_secyear.sale_type = 'w'
  and t_s_firstyear.dyear = 2001 and t_s_secyear.dyear = 2002
  and t_w_firstyear.dyear = 2001 and t_w_secyear.dyear = 2002
  and t_s_firstyear.year_total > 0 and t_w_firstyear.year_total > 0
  and t_w_secyear.year_total / t_w_firstyear.year_total
        > t_s_secyear.year_total / t_s_firstyear.year_total
order by t_s_secyear.customer_id, t_s_secyear.customer_first_name,
         t_s_secyear.customer_last_name
limit 100
"""

Q[12] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ws_ext_sales_price) as itemrevenue,
       sum(ws_ext_sales_price) * 100
         / sum(sum(ws_ext_sales_price)) over (partition by i_class)
         as revenueratio
from web_sales, item, date_dim
where ws_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and ws_sold_date_sk = d_date_sk
  and d_date between date '1999-02-22' and date '1999-02-22' + interval '30' day
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
"""

Q[13] = """
select avg(ss_quantity) q, avg(ss_ext_sales_price) e,
       avg(ss_ext_wholesale_cost) w, sum(ss_ext_wholesale_cost) sw
from store_sales, store, customer_demographics, household_demographics,
     customer_address, date_dim
where s_store_sk = ss_store_sk and ss_sold_date_sk = d_date_sk
  and d_year = 2001
  and ((ss_hdemo_sk = hd_demo_sk and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = 'M' and cd_education_status = 'Advanced Degree'
        and ss_sales_price between 100.00 and 150.00 and hd_dep_count = 3)
    or (ss_hdemo_sk = hd_demo_sk and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = 'S' and cd_education_status = 'College'
        and ss_sales_price between 50.00 and 100.00 and hd_dep_count = 1)
    or (ss_hdemo_sk = hd_demo_sk and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = 'W' and cd_education_status = '2 yr Degree'
        and ss_sales_price between 150.00 and 200.00 and hd_dep_count = 1))
  and ((ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('TX', 'OH', 'TX')
        and ss_net_profit between 100 and 200)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('OR', 'NM', 'KY')
        and ss_net_profit between 150 and 300)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('VA', 'TX', 'MS')
        and ss_net_profit between 50 and 250))
"""

Q[14] = """
with cross_items as (
  select i_item_sk ss_item_sk
  from item,
       (select iss.i_brand_id brand_id, iss.i_class_id class_id,
               iss.i_category_id category_id
        from store_sales, item iss, date_dim d1
        where ss_item_sk = iss.i_item_sk and ss_sold_date_sk = d1.d_date_sk
          and d1.d_year between 1999 and 2001
        intersect
        select ics.i_brand_id, ics.i_class_id, ics.i_category_id
        from catalog_sales, item ics, date_dim d2
        where cs_item_sk = ics.i_item_sk and cs_sold_date_sk = d2.d_date_sk
          and d2.d_year between 1999 and 2001
        intersect
        select iws.i_brand_id, iws.i_class_id, iws.i_category_id
        from web_sales, item iws, date_dim d3
        where ws_item_sk = iws.i_item_sk and ws_sold_date_sk = d3.d_date_sk
          and d3.d_year between 1999 and 2001) x
  where i_brand_id = brand_id and i_class_id = class_id
    and i_category_id = category_id),
 avg_sales as (
  select avg(quantity * list_price) average_sales
  from (select ss_quantity quantity, ss_list_price list_price
        from store_sales, date_dim
        where ss_sold_date_sk = d_date_sk and d_year between 1999 and 2001
        union all
        select cs_quantity quantity, cs_list_price list_price
        from catalog_sales, date_dim
        where cs_sold_date_sk = d_date_sk and d_year between 1999 and 2001
        union all
        select ws_quantity quantity, ws_list_price list_price
        from web_sales, date_dim
        where ws_sold_date_sk = d_date_sk and d_year between 1999 and 2001) x)
select channel, i_brand_id, i_class_id, i_category_id, sum(sales),
       sum(number_sales)
from (select 'store' channel, i_brand_id, i_class_id, i_category_id,
             sum(ss_quantity * ss_list_price) sales,
             count(*) number_sales
      from store_sales, item, date_dim
      where ss_item_sk in (select ss_item_sk from cross_items)
        and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(ss_quantity * ss_list_price)
               > (select average_sales from avg_sales)
      union all
      select 'catalog' channel, i_brand_id, i_class_id, i_category_id,
             sum(cs_quantity * cs_list_price) sales, count(*) number_sales
      from catalog_sales, item, date_dim
      where cs_item_sk in (select ss_item_sk from cross_items)
        and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(cs_quantity * cs_list_price)
               > (select average_sales from avg_sales)
      union all
      select 'web' channel, i_brand_id, i_class_id, i_category_id,
             sum(ws_quantity * ws_list_price) sales, count(*) number_sales
      from web_sales, item, date_dim
      where ws_item_sk in (select ss_item_sk from cross_items)
        and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(ws_quantity * ws_list_price)
               > (select average_sales from avg_sales)) y
group by rollup (channel, i_brand_id, i_class_id, i_category_id)
order by channel nulls last, i_brand_id nulls last, i_class_id nulls last,
         i_category_id nulls last
limit 100
"""

Q[15] = """
select ca_zip, sum(cs_sales_price)
from catalog_sales, customer, customer_address, date_dim
where cs_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and (substr(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405', '86475',
                                '85392', '85460', '80348', '81792')
       or ca_state in ('CA', 'WA', 'GA') or cs_sales_price > 500)
  and cs_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 2001
group by ca_zip
order by ca_zip
limit 100
"""

Q[16] = """
select count(distinct cs_order_number) as order_count,
       sum(cs_ext_ship_cost) as total_shipping_cost,
       sum(cs_net_profit) as total_net_profit
from catalog_sales cs1, date_dim, customer_address, call_center
where d_date between date '2002-02-01' and date '2002-02-01' + interval '60' day
  and cs1.cs_ship_date_sk = d_date_sk
  and cs1.cs_ship_addr_sk = ca_address_sk and ca_state = 'GA'
  and cs1.cs_call_center_sk = cc_call_center_sk
  and cc_county in ('Ziebach County', 'Williamson County', 'Walker County',
                    'Salem County', 'Raleigh County')
  and exists (select * from catalog_sales cs2
              where cs1.cs_order_number = cs2.cs_order_number
                and cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
  and not exists (select * from catalog_returns cr1
                  where cs1.cs_order_number = cr1.cr_order_number)
limit 100
"""

Q[17] = """
select i_item_id, i_item_desc, s_state, count(ss_quantity) as store_sales_quantitycount,
       avg(ss_quantity) as store_sales_quantityave,
       stddev_samp(ss_quantity) as store_sales_quantitystdev,
       stddev_samp(ss_quantity) / avg(ss_quantity) as store_sales_quantitycov,
       count(sr_return_quantity) as store_returns_quantitycount,
       avg(sr_return_quantity) as store_returns_quantityave,
       stddev_samp(sr_return_quantity) as store_returns_quantitystdev,
       stddev_samp(sr_return_quantity) / avg(sr_return_quantity)
         as store_returns_quantitycov,
       count(cs_quantity) as catalog_sales_quantitycount,
       avg(cs_quantity) as catalog_sales_quantityave,
       stddev_samp(cs_quantity) as catalog_sales_quantitystdev,
       stddev_samp(cs_quantity) / avg(cs_quantity) as catalog_sales_quantitycov
from store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
where d1.d_quarter_name = '2001Q1' and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_quarter_name in ('2001Q1', '2001Q2', '2001Q3')
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_quarter_name in ('2001Q1', '2001Q2', '2001Q3')
group by i_item_id, i_item_desc, s_state
order by i_item_id, i_item_desc, s_state
limit 100
"""

Q[18] = """
select i_item_id, ca_country, ca_state, ca_county,
       avg(cast(cs_quantity as double)) agg1,
       avg(cast(cs_list_price as double)) agg2,
       avg(cast(cs_coupon_amt as double)) agg3,
       avg(cast(cs_sales_price as double)) agg4,
       avg(cast(cs_net_profit as double)) agg5,
       avg(cast(c_birth_year as double)) agg6,
       avg(cast(cd1.cd_dep_count as double)) agg7
from catalog_sales, customer_demographics cd1, customer_demographics cd2,
     customer, customer_address, date_dim, item
where cs_sold_date_sk = d_date_sk and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd1.cd_demo_sk
  and cs_bill_customer_sk = c_customer_sk
  and cd1.cd_gender = 'F' and cd1.cd_education_status = 'Unknown'
  and c_current_cdemo_sk = cd2.cd_demo_sk
  and c_current_addr_sk = ca_address_sk
  and c_birth_month in (1, 6, 8, 9, 12, 2) and d_year = 1998
  and ca_state in ('MS', 'IN', 'ND', 'OK', 'NM', 'VA', 'MS')
group by rollup (i_item_id, ca_country, ca_state, ca_county)
order by ca_country nulls last, ca_state nulls last, ca_county nulls last,
         i_item_id nulls last
limit 100
"""

Q[19] = """
select i_brand_id brand_id, i_brand brand, i_manufact_id, i_manufact,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item, customer, customer_address, store
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = 8 and d_moy = 11 and d_year = 1998
  and ss_customer_sk = c_customer_sk and c_current_addr_sk = ca_address_sk
  and substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5) and ss_store_sk = s_store_sk
group by i_brand, i_brand_id, i_manufact_id, i_manufact
order by ext_price desc, i_brand, i_brand_id, i_manufact_id, i_manufact
limit 100
"""

Q[20] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(cs_ext_sales_price) as itemrevenue,
       sum(cs_ext_sales_price) * 100
         / sum(sum(cs_ext_sales_price)) over (partition by i_class)
         as revenueratio
from catalog_sales, item, date_dim
where cs_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and cs_sold_date_sk = d_date_sk
  and d_date between date '1999-02-22' and date '1999-02-22' + interval '30' day
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
"""

Q[21] = """
select w_warehouse_name, i_item_id,
       sum(case when d_date < date '2000-03-11' then inv_quantity_on_hand
                else 0 end) as inv_before,
       sum(case when d_date >= date '2000-03-11' then inv_quantity_on_hand
                else 0 end) as inv_after
from inventory, warehouse, item, date_dim
where i_current_price between 0.99 and 1.49 and i_item_sk = inv_item_sk
  and inv_warehouse_sk = w_warehouse_sk and inv_date_sk = d_date_sk
  and d_date between date '2000-03-11' - interval '30' day
                 and date '2000-03-11' + interval '30' day
group by w_warehouse_name, i_item_id
having (case when sum(case when d_date < date '2000-03-11'
                           then inv_quantity_on_hand else 0 end) > 0
             then cast(sum(case when d_date >= date '2000-03-11'
                                then inv_quantity_on_hand else 0 end)
                       as double)
                  / sum(case when d_date < date '2000-03-11'
                             then inv_quantity_on_hand else 0 end)
             else null end) between 0.666667 and 1.5
order by w_warehouse_name, i_item_id
limit 100
"""

Q[22] = """
select i_product_name, i_brand, i_class, i_category,
       avg(inv_quantity_on_hand) qoh
from inventory, date_dim, item
where inv_date_sk = d_date_sk and inv_item_sk = i_item_sk
  and d_month_seq between 350 and 350 + 11
group by rollup (i_product_name, i_brand, i_class, i_category)
order by qoh, i_product_name nulls last, i_brand nulls last,
         i_class nulls last, i_category nulls last
limit 100
"""

Q[23] = """
with frequent_ss_items as (
  select substr(i_item_desc, 1, 30) itemdesc, i_item_sk item_sk,
         d_date solddate, count(*) cnt
  from store_sales, date_dim, item
  where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
    and d_year in (2000, 2001, 2002, 2003)
  group by substr(i_item_desc, 1, 30), i_item_sk, d_date
  having count(*) > 4),
 max_store_sales as (
  select max(csales) tpcds_cmax
  from (select c_customer_sk, sum(ss_quantity * ss_sales_price) csales
        from store_sales, customer, date_dim
        where ss_customer_sk = c_customer_sk and ss_sold_date_sk = d_date_sk
          and d_year in (2000, 2001, 2002, 2003)
        group by c_customer_sk) x),
 best_ss_customer as (
  select c_customer_sk, sum(ss_quantity * ss_sales_price) ssales
  from store_sales, customer
  where ss_customer_sk = c_customer_sk
  group by c_customer_sk
  having sum(ss_quantity * ss_sales_price)
           > 0.5 * (select tpcds_cmax from max_store_sales))
select sum(sales)
from (select cs_quantity * cs_list_price sales
      from catalog_sales, date_dim
      where d_year = 2000 and d_moy = 2 and cs_sold_date_sk = d_date_sk
        and cs_item_sk in (select item_sk from frequent_ss_items)
        and cs_bill_customer_sk in (select c_customer_sk
                                    from best_ss_customer)
      union all
      select ws_quantity * ws_list_price sales
      from web_sales, date_dim
      where d_year = 2000 and d_moy = 2 and ws_sold_date_sk = d_date_sk
        and ws_item_sk in (select item_sk from frequent_ss_items)
        and ws_bill_customer_sk in (select c_customer_sk
                                    from best_ss_customer)) y
limit 100
"""

Q[24] = """
with ssales as (
  select c_last_name, c_first_name, s_store_name, ca_state, s_state,
         i_color, i_current_price, i_manager_id, i_units, i_size,
         sum(ss_net_paid) netpaid
  from store_sales, store_returns, store, item, customer, customer_address
  where ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk
    and ss_customer_sk = c_customer_sk and ss_item_sk = i_item_sk
    and ss_store_sk = s_store_sk and c_current_addr_sk = ca_address_sk
    and c_birth_country <> upper(ca_country) and s_zip = ca_zip
    and s_market_id = 8
  group by c_last_name, c_first_name, s_store_name, ca_state, s_state,
           i_color, i_current_price, i_manager_id, i_units, i_size)
select c_last_name, c_first_name, s_store_name, sum(netpaid) paid
from ssales
where i_color = 'red'
group by c_last_name, c_first_name, s_store_name
having sum(netpaid) > (select 0.05 * avg(netpaid) from ssales)
order by c_last_name, c_first_name, s_store_name
"""

Q[25] = """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) as store_sales_profit,
       sum(sr_net_loss) as store_returns_loss,
       sum(cs_net_profit) as catalog_sales_profit
from store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
where d1.d_moy = 4 and d1.d_year = 2001 and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 4 and 10 and d2.d_year = 2001
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_moy between 4 and 10 and d3.d_year = 2001
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
"""
