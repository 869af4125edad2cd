"""TPC-DS queries 26-50 as SQL text.

Copied from ``spark_rapids_tpu/tpcds/q26_50.py``.
"""

Q = {}

Q[26] = """
select i_item_id, avg(cs_quantity) agg1, avg(cs_list_price) agg2,
       avg(cs_coupon_amt) agg3, avg(cs_sales_price) agg4
from catalog_sales, customer_demographics, date_dim, item, promotion
where cs_sold_date_sk = d_date_sk and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk and cs_promo_sk = p_promo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N') and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
"""

Q[27] = """
select i_item_id, s_state, grouping(s_state) g_state,
       avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College' and d_year = 2002
  and s_state in ('TX', 'OH', 'CA', 'FL', 'GA', 'AL')
group by rollup (i_item_id, s_state)
order by i_item_id nulls last, s_state nulls last
limit 100
"""

Q[28] = """
select *
from (select avg(ss_list_price) b1_lp, count(ss_list_price) b1_cnt,
             count(distinct ss_list_price) b1_cntd
      from store_sales
      where ss_quantity between 0 and 5
        and (ss_list_price between 8 and 8 + 10
             or ss_coupon_amt between 459 and 459 + 1000
             or ss_wholesale_cost between 57 and 57 + 20)) b1,
     (select avg(ss_list_price) b2_lp, count(ss_list_price) b2_cnt,
             count(distinct ss_list_price) b2_cntd
      from store_sales
      where ss_quantity between 6 and 10
        and (ss_list_price between 90 and 90 + 10
             or ss_coupon_amt between 2323 and 2323 + 1000
             or ss_wholesale_cost between 31 and 31 + 20)) b2,
     (select avg(ss_list_price) b3_lp, count(ss_list_price) b3_cnt,
             count(distinct ss_list_price) b3_cntd
      from store_sales
      where ss_quantity between 11 and 15
        and (ss_list_price between 142 and 142 + 10
             or ss_coupon_amt between 12214 and 12214 + 1000
             or ss_wholesale_cost between 79 and 79 + 20)) b3,
     (select avg(ss_list_price) b4_lp, count(ss_list_price) b4_cnt,
             count(distinct ss_list_price) b4_cntd
      from store_sales
      where ss_quantity between 16 and 20
        and (ss_list_price between 135 and 135 + 10
             or ss_coupon_amt between 6071 and 6071 + 1000
             or ss_wholesale_cost between 38 and 38 + 20)) b4,
     (select avg(ss_list_price) b5_lp, count(ss_list_price) b5_cnt,
             count(distinct ss_list_price) b5_cntd
      from store_sales
      where ss_quantity between 21 and 25
        and (ss_list_price between 122 and 122 + 10
             or ss_coupon_amt between 836 and 836 + 1000
             or ss_wholesale_cost between 17 and 17 + 20)) b5,
     (select avg(ss_list_price) b6_lp, count(ss_list_price) b6_cnt,
             count(distinct ss_list_price) b6_cntd
      from store_sales
      where ss_quantity between 26 and 30
        and (ss_list_price between 154 and 154 + 10
             or ss_coupon_amt between 7326 and 7326 + 1000
             or ss_wholesale_cost between 7 and 7 + 20)) b6
limit 100
"""

Q[29] = """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) as store_sales_quantity,
       sum(sr_return_quantity) as store_returns_quantity,
       sum(cs_quantity) as catalog_sales_quantity
from store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
where d1.d_moy = 9 and d1.d_year = 1999 and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 9 and 9 + 3 and d2.d_year = 1999
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_year in (1999, 2000, 2001)
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
"""

Q[30] = """
with customer_total_return as (
  select wr_returning_customer_sk as ctr_customer_sk, ca_state as ctr_state,
         sum(wr_return_amt) as ctr_total_return
  from web_returns, date_dim, customer_address
  where wr_returned_date_sk = d_date_sk and d_year = 2002
    and wr_returning_addr_sk = ca_address_sk
  group by wr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name,
       c_preferred_cust_flag, c_birth_day, c_birth_month, c_birth_year,
       c_birth_country, c_login, c_email_address, c_last_review_date_sk,
       ctr_total_return
from customer_total_return ctr1, customer_address, customer
where ctr1.ctr_total_return > (select avg(ctr_total_return) * 1.2
                               from customer_total_return ctr2
                               where ctr1.ctr_state = ctr2.ctr_state)
  and ca_address_sk = c_current_addr_sk and ca_state = 'GA'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, c_salutation, c_first_name, c_last_name,
         c_preferred_cust_flag, c_birth_day, c_birth_month, c_birth_year,
         c_birth_country, c_login, c_email_address, c_last_review_date_sk,
         ctr_total_return
limit 100
"""

Q[31] = """
with ss as (
  select ca_county, d_qoy, d_year, sum(ss_ext_sales_price) as store_sales
  from store_sales, date_dim, customer_address
  where ss_sold_date_sk = d_date_sk and ss_addr_sk = ca_address_sk
  group by ca_county, d_qoy, d_year),
 ws as (
  select ca_county, d_qoy, d_year, sum(ws_ext_sales_price) as web_sales
  from web_sales, date_dim, customer_address
  where ws_sold_date_sk = d_date_sk and ws_bill_addr_sk = ca_address_sk
  group by ca_county, d_qoy, d_year)
select ss1.ca_county, ss1.d_year,
       ws2.web_sales / ws1.web_sales web_q1_q2_increase,
       ss2.store_sales / ss1.store_sales store_q1_q2_increase,
       ws3.web_sales / ws2.web_sales web_q2_q3_increase,
       ss3.store_sales / ss2.store_sales store_q2_q3_increase
from ss ss1, ss ss2, ss ss3, ws ws1, ws ws2, ws ws3
where ss1.d_qoy = 1 and ss1.d_year = 2000
  and ss1.ca_county = ss2.ca_county and ss2.d_qoy = 2 and ss2.d_year = 2000
  and ss2.ca_county = ss3.ca_county and ss3.d_qoy = 3 and ss3.d_year = 2000
  and ss1.ca_county = ws1.ca_county and ws1.d_qoy = 1 and ws1.d_year = 2000
  and ws1.ca_county = ws2.ca_county and ws2.d_qoy = 2 and ws2.d_year = 2000
  and ws1.ca_county = ws3.ca_county and ws3.d_qoy = 3 and ws3.d_year = 2000
  and case when ws1.web_sales > 0 then ws2.web_sales / ws1.web_sales
           else null end
        > case when ss1.store_sales > 0 then ss2.store_sales / ss1.store_sales
               else null end
  and case when ws2.web_sales > 0 then ws3.web_sales / ws2.web_sales
           else null end
        > case when ss2.store_sales > 0 then ss3.store_sales / ss2.store_sales
               else null end
order by ss1.ca_county
"""

Q[32] = """
select sum(cs_ext_discount_amt) as excess_discount_amount
from catalog_sales, item, date_dim
where i_manufact_id = 29 and i_item_sk = cs_item_sk
  and d_date between date '1999-01-07' and date '1999-01-07' + interval '90' day
  and d_date_sk = cs_sold_date_sk
  and cs_ext_discount_amt > (
    select 1.3 * avg(cs_ext_discount_amt)
    from catalog_sales, date_dim
    where cs_item_sk = i_item_sk and d_date_sk = cs_sold_date_sk
      and d_date between date '1999-01-07'
                     and date '1999-01-07' + interval '90' day)
limit 100
"""

Q[33] = """
with ss as (
  select i_manufact_id, sum(ss_ext_sales_price) total_sales
  from store_sales, date_dim, customer_address, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category in ('Electronics'))
    and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 5 and ss_addr_sk = ca_address_sk
    and ca_gmt_offset = -5.0
  group by i_manufact_id),
 cs as (
  select i_manufact_id, sum(cs_ext_sales_price) total_sales
  from catalog_sales, date_dim, customer_address, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category in ('Electronics'))
    and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 5 and cs_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5.0
  group by i_manufact_id),
 ws as (
  select i_manufact_id, sum(ws_ext_sales_price) total_sales
  from web_sales, date_dim, customer_address, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category in ('Electronics'))
    and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 5 and ws_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5.0
  group by i_manufact_id)
select i_manufact_id, sum(total_sales) total_sales
from (select * from ss
      union all
      select * from cs
      union all
      select * from ws) tmp1
group by i_manufact_id
order by total_sales, i_manufact_id
limit 100
"""

Q[34] = """
select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and (d_dom between 1 and 3 or d_dom between 25 and 28)
        and (hd_buy_potential = '>10000' or hd_buy_potential = 'Unknown')
        and hd_vehicle_count > 0
        and (case when hd_vehicle_count > 0
                  then cast(hd_dep_count as double) / hd_vehicle_count
                  else null end) > 1.2
        and d_year in (1999, 2000, 2001)
        and s_county in ('Ziebach County', 'Williamson County',
                         'Walker County', 'Salem County')
      group by ss_ticket_number, ss_customer_sk) dn,
     customer
where ss_customer_sk = c_customer_sk and cnt between 15 and 20
order by c_last_name, c_first_name, c_salutation,
         c_preferred_cust_flag desc, ss_ticket_number
"""

Q[35] = """
select ca_state, cd_gender, cd_marital_status, cd_dep_count, count(*) cnt1,
       min(cd_dep_count) mn1, max(cd_dep_count) mx1, avg(cd_dep_count) av1,
       cd_dep_employed_count, count(*) cnt2, min(cd_dep_employed_count) mn2,
       max(cd_dep_employed_count) mx2, avg(cd_dep_employed_count) av2,
       cd_dep_college_count, count(*) cnt3, min(cd_dep_college_count) mn3,
       max(cd_dep_college_count) mx3, avg(cd_dep_college_count) av3
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk and d_year = 2002
                and d_qoy < 4)
  and (exists (select * from web_sales, date_dim
               where c.c_customer_sk = ws_bill_customer_sk
                 and ws_sold_date_sk = d_date_sk and d_year = 2002
                 and d_qoy < 4)
    or exists (select * from catalog_sales, date_dim
               where c.c_customer_sk = cs_ship_customer_sk
                 and cs_sold_date_sk = d_date_sk and d_year = 2002
                 and d_qoy < 4))
group by ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
order by ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
limit 100
"""

Q[36] = """
select sum(ss_net_profit) / sum(ss_ext_sales_price) as gross_margin,
       i_category, i_class, grouping(i_category) + grouping(i_class)
         as lochierarchy,
       rank() over (partition by grouping(i_category) + grouping(i_class),
                    case when grouping(i_class) = 0 then i_category end
                    order by sum(ss_net_profit) / sum(ss_ext_sales_price) asc)
         as rank_within_parent
from store_sales, date_dim d1, item, store
where d1.d_year = 2001 and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and s_state in ('TX', 'OH', 'CA', 'FL', 'GA', 'AL')
group by rollup (i_category, i_class)
order by lochierarchy desc, case when lochierarchy = 0 then i_category end,
         rank_within_parent
limit 100
"""

Q[37] = """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, catalog_sales
where i_current_price between 68 and 68 + 30 and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and d_date between date '2000-02-01' and date '2000-02-01' + interval '60' day
  and i_manufact_id in (677, 940, 694, 808, 17, 128, 29)
  and inv_quantity_on_hand between 100 and 500 and cs_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
"""

Q[38] = """
select count(*)
from (select distinct c_last_name, c_first_name, d_date
      from store_sales, date_dim, customer
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_customer_sk = customer.c_customer_sk
        and d_month_seq between 360 and 360 + 11
      intersect
      select distinct c_last_name, c_first_name, d_date
      from catalog_sales, date_dim, customer
      where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
        and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
        and d_month_seq between 360 and 360 + 11
      intersect
      select distinct c_last_name, c_first_name, d_date
      from web_sales, date_dim, customer
      where web_sales.ws_sold_date_sk = date_dim.d_date_sk
        and web_sales.ws_bill_customer_sk = customer.c_customer_sk
        and d_month_seq between 360 and 360 + 11) hot_cust
limit 100
"""

Q[39] = """
with inv as (
  select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy, stdev, mean,
         case when mean = 0 then null else stdev / mean end cov
  from (select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy,
               stddev_samp(inv_quantity_on_hand) stdev,
               avg(inv_quantity_on_hand) mean
        from inventory, item, warehouse, date_dim
        where inv_item_sk = i_item_sk and inv_warehouse_sk = w_warehouse_sk
          and inv_date_sk = d_date_sk and d_year = 2001
        group by w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy) foo
  where case when mean = 0 then 0 else stdev / mean end > 1)
select inv1.w_warehouse_sk, inv1.i_item_sk, inv1.d_moy, inv1.mean, inv1.cov,
       inv2.w_warehouse_sk wsk2, inv2.i_item_sk isk2, inv2.d_moy moy2,
       inv2.mean mean2, inv2.cov cov2
from inv inv1, inv inv2
where inv1.i_item_sk = inv2.i_item_sk
  and inv1.w_warehouse_sk = inv2.w_warehouse_sk
  and inv1.d_moy = 1 and inv2.d_moy = 1 + 1
order by inv1.w_warehouse_sk, inv1.i_item_sk, inv1.d_moy, inv1.mean,
         inv1.cov, inv2.d_moy, inv2.mean, inv2.cov
"""

Q[40] = """
select w_state, i_item_id,
       sum(case when d_date < date '2000-03-11'
                then cs_sales_price - coalesce(cr_refunded_cash, 0)
                else 0 end) as sales_before,
       sum(case when d_date >= date '2000-03-11'
                then cs_sales_price - coalesce(cr_refunded_cash, 0)
                else 0 end) as sales_after
from catalog_sales
     left outer join catalog_returns
       on cs_order_number = cr_order_number and cs_item_sk = cr_item_sk,
     warehouse, item, date_dim
where i_current_price between 0.99 and 1.49 and i_item_sk = cs_item_sk
  and cs_warehouse_sk = w_warehouse_sk and cs_sold_date_sk = d_date_sk
  and d_date between date '2000-03-11' - interval '30' day
                 and date '2000-03-11' + interval '30' day
group by w_state, i_item_id
order by w_state, i_item_id
limit 100
"""

Q[41] = """
select distinct i_product_name
from item i1
where i_manufact_id between 738 and 738 + 40
  and (select count(*) as item_cnt
       from item
       where (i_manufact = i1.i_manufact
              and ((i_category = 'Women'
                    and (i_color = 'powder' or i_color = 'khaki')
                    and (i_units = 'Ounce' or i_units = 'Oz')
                    and (i_size = 'medium' or i_size = 'extra large'))
                or (i_category = 'Women'
                    and (i_color = 'brown' or i_color = 'honeydew')
                    and (i_units = 'Bunch' or i_units = 'Ton')
                    and (i_size = 'N/A' or i_size = 'small'))
                or (i_category = 'Men'
                    and (i_color = 'floral' or i_color = 'deep')
                    and (i_units = 'N/A' or i_units = 'Dozen')
                    and (i_size = 'petite' or i_size = 'large'))
                or (i_category = 'Men'
                    and (i_color = 'light' or i_color = 'cornflower')
                    and (i_units = 'Box' or i_units = 'Pound')
                    and (i_size = 'medium' or i_size = 'extra large'))))
          or (i_manufact = i1.i_manufact
              and ((i_category = 'Women'
                    and (i_color = 'midnight' or i_color = 'snow')
                    and (i_units = 'Pallet' or i_units = 'Gross')
                    and (i_size = 'medium' or i_size = 'extra large'))
                or (i_category = 'Women'
                    and (i_color = 'cyan' or i_color = 'papaya')
                    and (i_units = 'Cup' or i_units = 'Dram')
                    and (i_size = 'N/A' or i_size = 'small'))
                or (i_category = 'Men'
                    and (i_color = 'orange' or i_color = 'frosted')
                    and (i_units = 'Each' or i_units = 'Tbl')
                    and (i_size = 'petite' or i_size = 'large'))
                or (i_category = 'Men'
                    and (i_color = 'forest' or i_color = 'ghost')
                    and (i_units = 'Lb' or i_units = 'Gram')
                    and (i_size = 'medium' or i_size = 'extra large'))))
      ) > 0
order by i_product_name
limit 100
"""

Q[42] = """
select d_year, i_category_id, i_category, sum(ss_ext_sales_price) total
from date_dim dt, store_sales, item
where dt.d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = 1 and dt.d_moy = 11 and dt.d_year = 2000
group by d_year, i_category_id, i_category
order by total desc, d_year, i_category_id, i_category
limit 100
"""

Q[43] = """
select s_store_name, s_store_id,
       sum(case when d_day_name = 'Sunday' then ss_sales_price
                else null end) sun_sales,
       sum(case when d_day_name = 'Monday' then ss_sales_price
                else null end) mon_sales,
       sum(case when d_day_name = 'Tuesday' then ss_sales_price
                else null end) tue_sales,
       sum(case when d_day_name = 'Wednesday' then ss_sales_price
                else null end) wed_sales,
       sum(case when d_day_name = 'Thursday' then ss_sales_price
                else null end) thu_sales,
       sum(case when d_day_name = 'Friday' then ss_sales_price
                else null end) fri_sales,
       sum(case when d_day_name = 'Saturday' then ss_sales_price
                else null end) sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk and s_store_sk = ss_store_sk
  and s_gmt_offset = -5.0 and d_year = 2000
group by s_store_name, s_store_id
order by s_store_name, s_store_id, sun_sales, mon_sales, tue_sales,
         wed_sales, thu_sales, fri_sales, sat_sales
limit 100
"""

Q[44] = """
select asceding.rnk, i1.i_product_name best_performing,
       i2.i_product_name worst_performing
from (select *
      from (select item_sk, rank() over (order by rank_col asc) rnk
            from (select ss_item_sk item_sk, avg(ss_net_profit) rank_col
                  from store_sales ss1
                  where ss_store_sk = 4
                  group by ss_item_sk
                  having avg(ss_net_profit)
                           > 0.9 * (select avg(ss_net_profit) rank_col
                                    from store_sales
                                    where ss_store_sk = 4
                                      and ss_addr_sk is null
                                    group by ss_store_sk)) v1) v11
      where rnk < 11) asceding,
     (select *
      from (select item_sk, rank() over (order by rank_col desc) rnk
            from (select ss_item_sk item_sk, avg(ss_net_profit) rank_col
                  from store_sales ss1
                  where ss_store_sk = 4
                  group by ss_item_sk
                  having avg(ss_net_profit)
                           > 0.9 * (select avg(ss_net_profit) rank_col
                                    from store_sales
                                    where ss_store_sk = 4
                                      and ss_addr_sk is null
                                    group by ss_store_sk)) v2) v21
      where rnk < 11) descending,
     item i1, item i2
where asceding.rnk = descending.rnk and i1.i_item_sk = asceding.item_sk
  and i2.i_item_sk = descending.item_sk
order by asceding.rnk
limit 100
"""

Q[45] = """
select ca_zip, ca_city, sum(ws_sales_price)
from web_sales, customer, customer_address, date_dim, item
where ws_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk and ws_item_sk = i_item_sk
  and (substr(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405',
                                '86475', '85392', '85460', '80348', '81792')
       or i_item_id in (select i_item_id from item
                        where i_item_sk in (2, 3, 5, 7, 11, 13, 17, 19, 23,
                                            29)))
  and ws_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 2001
group by ca_zip, ca_city
order by ca_zip, ca_city
limit 100
"""

Q[46] = """
select c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number,
       amt, profit
from (select ss_ticket_number, ss_customer_sk, ca_city bought_city,
             sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
        and (hd_dep_count = 4 or hd_vehicle_count = 3)
        and d_dow in (6, 0) and d_year in (1999, 2000, 2001)
        and s_city in ('Fairview', 'Midway', 'Fairview', 'Fairview',
                       'Fairview')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and customer.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number
limit 100
"""

Q[47] = """
with v1 as (
  select i_category, i_brand, s_store_name, s_company_name, d_year, d_moy,
         sum(ss_sales_price) sum_sales,
         avg(sum(ss_sales_price)) over (partition by i_category, i_brand,
                                        s_store_name, s_company_name, d_year)
           avg_monthly_sales,
         rank() over (partition by i_category, i_brand, s_store_name,
                      s_company_name
                      order by d_year, d_moy) rn
  from item, store_sales, date_dim, store
  where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and (d_year = 1999 or (d_year = 1998 and d_moy = 12)
         or (d_year = 2000 and d_moy = 1))
  group by i_category, i_brand, s_store_name, s_company_name, d_year, d_moy),
 v2 as (
  select v1.i_category, v1.i_brand, v1.s_store_name, v1.s_company_name,
         v1.d_year, v1.d_moy, v1.avg_monthly_sales, v1.sum_sales,
         v1_lag.sum_sales psum, v1_lead.sum_sales nsum
  from v1, v1 v1_lag, v1 v1_lead
  where v1.i_category = v1_lag.i_category
    and v1.i_category = v1_lead.i_category
    and v1.i_brand = v1_lag.i_brand and v1.i_brand = v1_lead.i_brand
    and v1.s_store_name = v1_lag.s_store_name
    and v1.s_store_name = v1_lead.s_store_name
    and v1.s_company_name = v1_lag.s_company_name
    and v1.s_company_name = v1_lead.s_company_name
    and v1.rn = v1_lag.rn + 1 and v1.rn = v1_lead.rn - 1)
select *
from v2
where d_year = 1999 and avg_monthly_sales > 0
  and case when avg_monthly_sales > 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else null end > 0.1
order by sum_sales - avg_monthly_sales, 3
limit 100
"""

Q[48] = """
select sum(ss_quantity)
from store_sales, store, customer_demographics, customer_address, date_dim
where s_store_sk = ss_store_sk and ss_sold_date_sk = d_date_sk
  and d_year = 2000
  and ((cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'M'
        and cd_education_status = '4 yr Degree'
        and ss_sales_price between 100.00 and 150.00)
    or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'D'
        and cd_education_status = '2 yr Degree'
        and ss_sales_price between 50.00 and 100.00)
    or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'S'
        and cd_education_status = 'College'
        and ss_sales_price between 150.00 and 200.00))
  and ((ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('CO', 'OH', 'TX') and ss_net_profit between 0 and 2000)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('OR', 'MN', 'KY')
        and ss_net_profit between 150 and 3000)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('VA', 'CA', 'MS')
        and ss_net_profit between 50 and 25000))
"""

Q[49] = """
select channel, item, return_ratio, return_rank, currency_rank
from (select 'web' as channel, web.item, web.return_ratio,
             web.return_rank, web.currency_rank
      from (select item, return_ratio, currency_ratio,
                   rank() over (order by return_ratio) as return_rank,
                   rank() over (order by currency_ratio) as currency_rank
            from (select ws.ws_item_sk as item,
                         cast(sum(coalesce(wr.wr_return_quantity, 0))
                              as double)
                           / cast(sum(coalesce(ws.ws_quantity, 0))
                                  as double) as return_ratio,
                         cast(sum(coalesce(wr.wr_return_amt, 0)) as double)
                           / cast(sum(coalesce(ws.ws_net_paid, 0))
                                  as double) as currency_ratio
                  from web_sales ws
                       left outer join web_returns wr
                         on ws.ws_order_number = wr.wr_order_number
                        and ws.ws_item_sk = wr.wr_item_sk,
                       date_dim
                  where wr.wr_return_amt > 100 and ws.ws_net_profit > 1
                    and ws.ws_net_paid > 0 and ws.ws_quantity > 0
                    and ws_sold_date_sk = d_date_sk and d_year = 2001
                    and d_moy = 12
                  group by ws.ws_item_sk) in_web) web
      where web.return_rank <= 10 or web.currency_rank <= 10
      union
      select 'catalog' as channel, catalog.item, catalog.return_ratio,
             catalog.return_rank, catalog.currency_rank
      from (select item, return_ratio, currency_ratio,
                   rank() over (order by return_ratio) as return_rank,
                   rank() over (order by currency_ratio) as currency_rank
            from (select cs.cs_item_sk as item,
                         cast(sum(coalesce(cr.cr_return_quantity, 0))
                              as double)
                           / cast(sum(coalesce(cs.cs_quantity, 0))
                                  as double) as return_ratio,
                         cast(sum(coalesce(cr.cr_return_amount, 0))
                              as double)
                           / cast(sum(coalesce(cs.cs_net_paid, 0))
                                  as double) as currency_ratio
                  from catalog_sales cs
                       left outer join catalog_returns cr
                         on cs.cs_order_number = cr.cr_order_number
                        and cs.cs_item_sk = cr.cr_item_sk,
                       date_dim
                  where cr.cr_return_amount > 100 and cs.cs_net_profit > 1
                    and cs.cs_net_paid > 0 and cs.cs_quantity > 0
                    and cs_sold_date_sk = d_date_sk and d_year = 2001
                    and d_moy = 12
                  group by cs.cs_item_sk) in_cat) catalog
      where catalog.return_rank <= 10 or catalog.currency_rank <= 10
      union
      select 'store' as channel, store.item, store.return_ratio,
             store.return_rank, store.currency_rank
      from (select item, return_ratio, currency_ratio,
                   rank() over (order by return_ratio) as return_rank,
                   rank() over (order by currency_ratio) as currency_rank
            from (select sts.ss_item_sk as item,
                         cast(sum(coalesce(sr.sr_return_quantity, 0))
                              as double)
                           / cast(sum(coalesce(sts.ss_quantity, 0))
                                  as double) as return_ratio,
                         cast(sum(coalesce(sr.sr_return_amt, 0)) as double)
                           / cast(sum(coalesce(sts.ss_net_paid, 0))
                                  as double) as currency_ratio
                  from store_sales sts
                       left outer join store_returns sr
                         on sts.ss_ticket_number = sr.sr_ticket_number
                        and sts.ss_item_sk = sr.sr_item_sk,
                       date_dim
                  where sr.sr_return_amt > 100 and sts.ss_net_profit > 1
                    and sts.ss_net_paid > 0 and sts.ss_quantity > 0
                    and ss_sold_date_sk = d_date_sk and d_year = 2001
                    and d_moy = 12
                  group by sts.ss_item_sk) in_store) store
      where store.return_rank <= 10 or store.currency_rank <= 10) x
order by 1, 4, 5, 2
limit 100
"""

Q[50] = """
select s_store_name, s_company_id, s_street_number, s_street_name,
       s_street_type, s_suite_number, s_city, s_county, s_state, s_zip,
       sum(case when sr_returned_date_sk - ss_sold_date_sk <= 30
                then 1 else 0 end) as days30,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 30
                 and sr_returned_date_sk - ss_sold_date_sk <= 60
                then 1 else 0 end) as days60,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 60
                 and sr_returned_date_sk - ss_sold_date_sk <= 90
                then 1 else 0 end) as days90,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 90
                 and sr_returned_date_sk - ss_sold_date_sk <= 120
                then 1 else 0 end) as days120,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 120
                then 1 else 0 end) as days_more_120
from store_sales, store_returns, store, date_dim d1, date_dim d2
where d2.d_year = 2001 and d2.d_moy = 8
  and ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk
  and ss_sold_date_sk = d1.d_date_sk and sr_returned_date_sk = d2.d_date_sk
  and ss_customer_sk = sr_customer_sk and ss_store_sk = s_store_sk
group by s_store_name, s_company_id, s_street_number, s_street_name,
         s_street_type, s_suite_number, s_city, s_county, s_state, s_zip
order by s_store_name, s_company_id, s_street_number, s_street_name,
         s_street_type, s_suite_number, s_city, s_county, s_state, s_zip
limit 100
"""
